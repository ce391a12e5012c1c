"""The harness is driven by the configuration's comparison: a second
engine (a stub driver and comparison, with files that no manifest lists)
runs, is judged and is reported through ``run.py`` with no edit to it; the
column comparison gives what the column reference gave before; and the
four-card column cell on four gloo ranks on the CPU."""
import copy
import importlib
import json
import subprocess
import sys
import time
import types
from unittest import mock

import numpy as np
import pytest
import torch

import run
from conftest import HERE, ROOT
from core.trace import Trace
from reference import columns, compare, world as ref_world

SEED = 2 ** 31 + 977
CPU = torch.device('cpu')
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


# ---- a stub second engine ----

def _stub_window(c, seed, seconds, trace, device, start_epoch):
    """The stub program: squares of seeded integers, one march a batch of
    ``members``, until ``seconds`` have passed.  Traffic ``alter`` changes
    one answer; ``load_jax`` loads a module named ``jax``."""
    tr = c['traffic']
    if tr.get('load_jax'):
        sys.modules['jax'] = types.ModuleType('jax')
    setup_s = time.time() - start_epoch
    marches, t0 = [], time.perf_counter()
    while not marches or time.perf_counter() - t0 < seconds:
        x = _stub_inputs(seed, len(marches), int(tr['members']))
        y = torch.as_tensor(x) ** 2
        if tr.get('alter'):
            y[0] += 1
        # the answers go under ``sample``, which the harness drops from a
        # march's record once it is compared
        marches.append(dict(members=len(x), days=1.0, traced=None,
                            sample=y.numpy()))
    return dict(setup_s=setup_s, marches=marches, peak_bytes=0,
                window_wall=time.perf_counter() - t0, traces=[],
                host_trace=None)


def _stub_inputs(seed, j, n):
    return np.random.default_rng([seed, j]).integers(-1000, 1000, n)


def _stub_numbers(run_, c, seed, device):
    """The stub reference: each march's squares worked out again."""
    return _stub_judged(seed, [m['sample'] for m in run_['marches']])


def _stub_judged(seed, answers):
    wrong, gap = 0, 0.0
    for j, y in enumerate(answers):
        want = _stub_inputs(seed, j, len(y)).astype(np.float64) ** 2
        diff = np.abs(np.asarray(y, np.float64) - want)
        wrong += int((diff > 0).sum())
        gap = max(gap, float(diff.max()))
    return {'wrong_answers': wrong, 'square_gap': gap}


def _stub_control(c, seed, dtype, device):
    """The stub's control: the reference's squares of one march computed
    in ``dtype``."""
    x = _stub_inputs(seed, 0, int(c['traffic']['members']))
    y = torch.as_tensor(x, dtype=getattr(torch, dtype), device=device) ** 2
    return _stub_judged(seed, [y.double().cpu().numpy()])


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """A function of traffic keywords: the stub cell, loaded by
    ``run.load_cell`` from files under ``tmp_path`` beside a copy of
    ``BENCHMARK.json`` that lists them too; the repo's manifest does
    not."""
    monkeypatch.setitem(sys.modules, 'drivers.stub_engine', _module(
        'drivers.stub_engine', window=_stub_window))
    monkeypatch.setitem(sys.modules, 'reference.stub_engine', _module(
        'reference.stub_engine', numbers=_stub_numbers,
        control=_stub_control, FAILED='wrong_answers',
        REQUIRED=('wrong_answers', 'square_gap')))
    manifest = copy.deepcopy(BENCH)
    manifest['configs'].append({'name': 'stub',
                                'file': 'benchmark/configs/stub.json'})
    manifest['workloads'].append({'name': 'stub.tiny', 'config': 'stub',
                                  'traffic': 'tiny', 'chips': 1,
                                  'why': 'a second engine'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(manifest))
    bench = tmp_path / 'benchmark'
    files = {'configs/stub.json': {'name': 'stub', 'compare': 'stub_engine'},
             'cells/stub.tiny.json': {
                 'who': 'a test', 'why': 'a second engine',
                 'limits': {'wrong_answers': 0, 'square_gap': 0.0}}}
    for path, data in files.items():
        (bench / path).parent.mkdir(parents=True, exist_ok=True)
        (bench / path).write_text(json.dumps(data))
    (bench / 'traffic').mkdir()

    def make(**traffic):
        (bench / 'traffic' / 'tiny.json').write_text(json.dumps(
            dict(driver='stub_engine', members=5, **traffic)))
        return run.load_cell('stub.tiny', root=tmp_path)
    return make


def _reported(c, capsys):
    r = run.measure(c, SEED, 0.05, 0, CPU)
    assert run.report(c, r, 0) == 0
    return r, json.loads(capsys.readouterr().out.splitlines()[-1])


def test_a_second_engine_runs_through_the_harness(stub, capsys):
    r, line = _reported(stub(), capsys)
    assert line['correct'] is True, r['lines']
    assert line['attempted'] == 5 * len(r['marches'])
    assert line['failed'] == 0
    assert set(line['metrics']) == {'model_days_per_s',
                                    'peak_device_mem_gib', 'setup_s'}
    assert set(line['compared']) == {'wrong_answers', 'square_gap'}


def test_a_second_engine_with_an_altered_answer_is_not_correct(stub, capsys):
    r, line = _reported(stub(alter=1), capsys)
    assert line['correct'] is False
    # ``failed`` reads the comparison's own FAILED number
    assert line['failed'] == len(r['marches'])
    assert line['failed'] == line['compared']['wrong_answers']['value']
    assert 'unsettled' not in line['compared']


def test_a_second_engines_control_is_not_correct(stub):
    c = stub()
    ok, lines = run.judge(c, run.comparison(c).control(c, SEED, 'bfloat16',
                                                       CPU))
    assert not ok, lines


def test_a_second_engine_that_loads_jax_gives_no_result(stub, capsys):
    assert 'jax' not in sys.modules
    c = stub(load_jax=1)
    try:
        r = run.measure(c, SEED, 0.05, 0, CPU)
        assert run.report(c, r, 0) == 3
    finally:
        sys.modules.pop('jax', None)
    out = capsys.readouterr()
    assert out.out == '' and "['jax']" in out.err


def test_a_configuration_without_its_comparison_is_refused(stub, tmp_path):
    stub()
    path = tmp_path / 'benchmark/configs/stub.json'
    path.write_text(json.dumps({'name': 'stub'}))
    with pytest.raises(SystemExit, match='benchmark/configs/stub.json'):
        stub()


def test_each_comparison_loads_nothing_of_the_program():
    """The comparisons the configurations name are plain references."""
    names = sorted({json.loads((ROOT / c['file']).read_text())['compare']
                    for c in BENCH['configs']})
    code = (f'import importlib, sys; sys.path.insert(0, "{HERE}")\n'
            f'for n in {names!r}:\n'
            '    importlib.import_module("reference." + n)\n'
            'print(*sorted({m.split(".")[0] for m in sys.modules if '
            'm.startswith(("climatemodel", "jax", "flax"))}), "END")')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': ''})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['END']


# ---- the column comparison against the column reference called
# directly, on the record of a tiny seeded run of each cell ----


def _column_cells(driver):
    """The manifest's cells whose configuration compares by ``columns``
    and whose traffic names ``driver``."""
    configs = {c['name']: json.loads((ROOT / c['file']).read_text())
               for c in BENCH['configs']}
    return sorted(
        w['name'] for w in BENCH['workloads']
        if configs[w['config']]['compare'] == 'columns'
        and json.loads((ROOT / 'benchmark/traffic' / f"{w['traffic']}.json")
                       .read_text())['driver'] == driver)


#: members (a rank, on ranks) of the tiny runs
TINY = 6
RANKS_TINY = 3


def _recorded(cell, members, seconds=0.3, trace=0):
    """A tiny run of ``cell`` through ``run.measure``, and a copy of its
    driver's record made before the comparison read it."""
    c = run.load_cell(cell)
    c['traffic']['members'] = members
    driver = importlib.import_module(f"drivers.{c['traffic']['driver']}")
    kept = []

    def window(*a):
        rec = real(*a)
        kept.append(copy.deepcopy(rec))
        return rec
    real = driver.window
    with mock.patch.object(driver, 'window', window):
        r = run.measure(c, SEED, seconds, trace, CPU)
    return c, r, kept[0]


def _old_path(rec, c):
    marches = rec['marches']
    sample = {k: np.concatenate([m['sample'][k] for m in marches])
              for k in marches[0]['sample']}
    world = ref_world.grey_world(c['config'])
    nums = compare.numbers(sample, world, c['config'], seed=SEED,
                           device=CPU)
    nums['unsettled'] = sum(m['unsettled'] for m in marches)
    return nums


@pytest.fixture(scope='module')
def ranks_run():
    """One traced run of the four-card cell on four gloo ranks."""
    return _recorded('grey_rce.dp4x512k', RANKS_TINY, seconds=0.1, trace=1)


def test_the_column_cells_are_found():
    assert {'grey_rce.sweep512k', 'rce_conv.reference32k'} <= set(
        _column_cells('column_sweep'))
    assert 'grey_rce.dp4x512k' in _column_cells('grey_ranks')


@pytest.mark.parametrize('cell', _column_cells('column_sweep'))
def test_columns_compare_as_the_column_reference(cell, monkeypatch):
    monkeypatch.setattr(compare, 'MARCH_SAMPLE', 24)
    c, r, rec = _recorded(cell, TINY)
    assert r['correct'] is True, r['lines']
    assert run.comparison(c) is columns
    old = _old_path(rec, c)
    assert list(r['compared'].items()) == list(old.items())
    assert columns.numbers(rec, c, SEED, CPU) == old


def test_the_ranks_cell_compares_as_the_column_reference(ranks_run):
    c, r, rec = ranks_run
    assert r['correct'] is True, r['lines']
    assert list(r['compared'].items()) == list(_old_path(rec, c).items())


# ---- the four-card cell's readers on the ranks' record ----

#: the per-layer metrics of the four-card cell that read what the CPU
#: ranks record (the host clock and the program's counters); the card's
#: kernels are read below from traces put in the ranks' place
HOST_READ = ('iteration_ms', 'lockstep_iterations', 'f64_finish_s',
             'step_mfu', 'rank_imbalance', 'finish_iterations',
             'finish_repeats', 'finish_members')
CARD_READ = ('device_ops_per_iter', 'net_stats_walk_roofline',
             'device_idle_share')
#: rank 0's spans of its traced march, against its card's kernels
SPAN_READ = ('dispatch_ms_per_iter', 'stop_check_ms_per_iter',
             'idle_at_sync_share', 'idle_in_dispatch_share')


def test_the_ranks_cell_lists_the_readers_tested_here(ranks_run):
    c, _, _ = ranks_run
    assert {m['name'] for m in c['per_layer']} == set(
        HOST_READ + CARD_READ + SPAN_READ)


def test_the_ranks_cell_reads_rank_0s_spans(ranks_run):
    """Rank 0's span log comes back with the run; its traced march's spans
    read against kernels put by hand inside that march (rank 0's trace),
    one every 50 us."""
    from metrics import _spans
    c, r, _ = ranks_run
    assert r['spans'], 'rank 0 returned no span log'
    tops = _spans._tops(r, 'march', r['spans'])
    top = next(s for s, m in zip(tops, r['marches'])
               if m['traced'] == 'device')
    n = max(1, (top.end_ns - top.start_ns) // 100_000)
    ks = [((top.start_ns + 100_000 * i) * 1e-9,
           (top.start_ns + 100_000 * i + 50_000) * 1e-9, 'k')
          for i in range(n)]
    window = (top.end_ns - top.start_ns) * 1e-9
    r = dict(r, traces=[Trace(ks, [], window)] + r['traces'][1:])
    assert _spans.traced_march(r)[0] == top
    out = run.result(c, r, 1)['metrics']
    for name in SPAN_READ:
        assert out[name]['value'] >= 0, name
    assert out['dispatch_ms_per_iter']['value'] > 0
    assert (out['idle_at_sync_share']['value']
            + out['idle_in_dispatch_share']['value']
            <= out['device_idle_share']['value'] + 1e-9)


def test_the_ranks_cell_reads_its_host_metrics(ranks_run):
    c, r, _ = ranks_run
    out = run.result(c, r, 1)
    assert out['correct'] is True
    for name in HOST_READ:
        assert out['metrics'][name]['value'] >= 0, name
    own = [[m['own_iterations'] for m in ms] for ms in r['rank_marches']]
    assert len(own) == 4
    # a march's lock-step iterations are the slowest rank's
    assert [m['iterations'] for m in r['marches']] == [max(x) for x in
                                                       zip(*own)]


def test_the_ranks_cell_reads_rank_0s_traced_march(ranks_run):
    """Each rank's trace replaced by kernels put by hand: K3 and an NCCL
    gather an own iteration, each 1 ms, over a window of 4 ms an
    iteration; the readers take rank 0's, and the slowest rank's gather."""
    c, r, _ = ranks_run
    own = [next(m['own_iterations'] for m in ms if m['traced'] == 'device')
           for ms in r['rank_marches']]

    def trace(its, nccl_ms):
        ks = []
        for i in range(its):
            t = 4e-3 * i
            ks += [(t, t + 1e-3, 'net_stats_walk_kernel'),
                   (t + 2e-3, t + 2e-3 + nccl_ms * 1e-3,
                    'ncclDevKernel_AllGather_RING_LL')]
        return Trace(ks, [], 4e-3 * its)
    r = dict(r, traces=[trace(n, 1.0 + k) for k, n in enumerate(own)])
    out = run.result(c, r, 1)['metrics']
    assert out['device_ops_per_iter']['value'] == 2.0
    assert out['device_idle_share']['value'] == pytest.approx(50.0)
    # kept for a later manifest: it read nothing in one traced run of four
    # on the card (PERF.md, section 7)
    from metrics import collective_ms_per_iter
    assert collective_ms_per_iter.read(r) == pytest.approx(4.0)
    from core.yardstick import net_stats_walk_bytes, roofline_percent
    assert out['net_stats_walk_roofline']['value'] == pytest.approx(
        roofline_percent(net_stats_walk_bytes(RANKS_TINY, 59), 1e-3))


@pytest.mark.parametrize('fault', ['exchange_left_out', 'state_unchanged',
                                   'half_left_out', 'answer_altered'])
def test_a_broken_ranks_cell_is_not_correct(fault):
    import rank_faults
    from drivers import grey_ranks
    c = run.load_cell('grey_rce.dp4x512k')
    c['traffic']['members'] = RANKS_TINY
    with mock.patch.object(grey_ranks, 'rank_window',
                           getattr(rank_faults, fault)):
        r = run.measure(c, SEED, 0.1, 0, CPU)
    assert r['correct'] is False, r['lines']
