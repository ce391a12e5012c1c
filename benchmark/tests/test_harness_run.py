"""A tiny cell end to end on the CPU, the result line, the exit
without a card, and the faults the comparison must catch."""
import json
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import run
from conftest import ROOT

TINY = {'grey_rce.sweep512k': 12, 'rce_conv.reference32k': 6}
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _few_marched_again(monkeypatch):
    """The reference marches again a few members on the CPU: a window of
    a broken march that returns at once holds thousands of marches."""
    from reference import compare
    monkeypatch.setattr(compare, 'MARCH_SAMPLE', 24)


def tiny(cell):
    c = run.load_cell(cell)
    c['traffic']['members'] = TINY[cell]
    return c


def once(c, trace=0):
    r = run.measure(c, SEED, 0.5, trace, torch.device('cpu'))
    return r, run.result(c, r, trace)


@pytest.mark.parametrize('cell', sorted(TINY))
def test_tiny_cell_prints_the_result_line(cell, capsys):
    c = tiny(cell)
    r, out = once(c)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'compared'
    assert line['correct'] is True, r['lines']
    assert line['attempted'] == TINY[cell] * len(r['marches'])
    assert set(line['metrics']) == {'model_days_per_s',
                                    'peak_device_mem_gib', 'setup_s'}
    assert all(v['value'] >= 0 for v in line['metrics'].values())
    for k, v in line['compared'].items():
        assert v['value'] <= v['limit'], k


def test_same_seed_same_inputs():
    """The seed fixes the sweep's order in every march (and its values,
    where the traffic moves them); every seed marches the same set."""
    from drivers.column_sweep import forcings, order
    t = tiny('grey_rce.sweep512k')['traffic']
    B = t['members']
    assert np.array_equal(order(SEED, 3, B), order(SEED, 3, B))
    assert not np.array_equal(order(SEED, 0, B), order(SEED + 1, 0, B))
    assert np.array_equal(np.sort(forcings(t, SEED)),
                          np.sort(forcings(t, SEED + 1)))
    moved = dict(t, jitter=1.0)
    assert np.array_equal(forcings(moved, SEED), forcings(moved, SEED))
    assert not np.array_equal(forcings(moved, SEED),
                              forcings(moved, SEED + 1))


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'grey_rce.sweep512k', '--seed', '1', '--seconds', '1', '--trace',
         '0'], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'CUDA_VISIBLE_DEVICES': ''})
    assert out.returncode == 2 and out.stdout == ''
    assert 'CUDA device' in out.stderr


def test_program_alone_is_needed(tmp_path):
    """In a directory with only BENCHMARK.json and benchmark/, no run."""
    import shutil
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'grey_rce.sweep512k', '--seed', '1', '--seconds', '1', '--trace',
         '0'], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0 and out.stdout == ''


# ---- the timed path broken underneath: each must read correct False ----

def _unchanged(states, forcings, *a, **k):
    """A march whose step returns its state unchanged, claiming
    equilibrium."""
    from climatemodel_tpu_torch.models.column import EquilibriumInfo
    B = states.T.shape[0]
    yes = torch.ones(B, dtype=torch.bool)
    no = torch.zeros(B, dtype=torch.bool)
    z = torch.zeros(B)
    return states, EquilibriumInfo(steps=torch.ones(B, dtype=torch.int32),
                                   delta_net_flux=z, flux_thresh=z,
                                   failed=no, equilibrium=yes, nan=no,
                                   timed_out=no)


def _half(real):
    """Only the first half of the members marched; the rest returned as
    they came, flagged as the marched ones."""
    def march(states, forcings, *a, **k):
        fs, info = real(states, forcings, *a, **k)
        h = states.T.shape[0] // 2
        T = fs.T.clone()
        T[h:] = states.T[h:]
        net = fs.net_flux.clone()
        net[h:] = states.net_flux[h:]
        return fs.replace(T=T, net_flux=net), info
    return march


def _altered(real):
    """One member's answer altered where it is produced."""
    def march(states, forcings, *a, **k):
        fs, info = real(states, forcings, *a, **k)
        T = fs.T.clone()
        T[0] *= 1.02
        return fs.replace(T=T), info
    return march


def _early(real):
    """Each member stopped once its step's flux change falls under 5 W/m2
    (fifty times the configuration's threshold)."""
    def march(states, forcings, p_int, p_c, flux_thresh, *a, **k):
        return real(states, forcings, p_int, p_c, 50 * flux_thresh, *a, **k)
    return march


@pytest.mark.parametrize('cell', ['grey_rce.sweep512k',
                                  'rce_conv.reference32k'])
@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    from climatemodel_tpu_torch.models import ensemble
    real = ensemble.grey_evolve_ensemble
    fake = {'unchanged': _unchanged, 'half': _half(real),
            'altered': _altered(real)}[fault]
    c = tiny(cell)
    with mock.patch.object(ensemble, 'grey_evolve_ensemble', fake):
        r, out = once(c)
    assert out['correct'] is False, r['lines']


def _unconserving(rows, pi, w, thresh, method='reference'):
    """A stable profile that does not conserve the column's enthalpy:
    potential temperature raised to the largest below it."""
    return torch.cummax(rows / pi, 1).values * pi


@pytest.mark.parametrize('fault', ['early', 'unconserving'])
def test_a_convective_march_off_its_equilibrium_is_not_correct(fault):
    """Stable columns whose last step moved little, yet away from the
    radiative-convective equilibrium: only ``t_p95_gap_k`` can tell."""
    from climatemodel_tpu_torch.models import ensemble
    from climatemodel_tpu_torch.ops import convection
    c = tiny('rce_conv.reference32k')
    patch = (mock.patch.object(ensemble, 'grey_evolve_ensemble',
                               _early(ensemble.grey_evolve_ensemble))
             if fault == 'early' else
             mock.patch.object(convection, 'adjust_rows', _unconserving))
    with patch:
        r, out = once(c)
    assert out['correct'] is False, r['lines']
    failed = {k for k, v in out['compared'].items()
              if not v['value'] <= v['limit']}
    assert failed == {'t_p95_gap_k'}, r['lines']


# ---- the cell on ranks (its files wait for a later manifest): four gloo
# ranks on the CPU ----

DP4 = {'name': 'grey_rce.dp4', 'config': 'grey_rce', 'traffic': 'dp4',
       'chips': 4, 'why': json.loads(
           (ROOT / 'benchmark/cells/grey_rce.dp4.json').read_text())['why']}


def tiny_ranks():
    c = run.load_cell('grey_rce.dp4', entry=DP4)
    c['traffic']['members'] = 3
    return c


def test_ranks_cell_on_the_cpu():
    c = tiny_ranks()
    r, out = once(c, trace=1)
    assert out['correct'] is True, r['lines']
    # the host-clock metrics time marches made before any profiling
    kinds = [m['traced'] for m in r['marches']]
    assert kinds[0] is None and kinds[-2:] == ['device', 'host']
    assert out['attempted'] == 12 * len(r['marches'])
    assert len(r['rank_marches']) == 4
    from metrics import rank_imbalance
    assert rank_imbalance.read(r) >= 0


def test_a_rank_that_loads_jax_gives_no_result(capsys):
    import rank_faults
    from drivers import grey_ranks
    c = tiny_ranks()
    with mock.patch.object(grey_ranks, 'rank_window',
                           rank_faults.loads_jax):
        r = run.measure(c, SEED, 0.1, 0, torch.device('cpu'))
    assert r['forbidden'] == ['jax']
    assert run.report(c, r, 0) == 3
    out = capsys.readouterr()
    assert out.out == '' and "['jax']" in out.err


@pytest.mark.parametrize('fault', ['exchange_left_out', 'state_unchanged'])
def test_a_broken_ranks_path_is_not_correct(fault):
    import rank_faults
    from drivers import grey_ranks
    c = tiny_ranks()
    with mock.patch.object(grey_ranks, 'rank_window',
                           getattr(rank_faults, fault)):
        r, out = once(c)
    assert out['correct'] is False, r['lines']
