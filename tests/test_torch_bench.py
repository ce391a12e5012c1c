"""The port's bench, ``python -m climatemodel_tpu_torch.bench``, on the CPU:
its command line and record (one JSON line, the full record where --out
says, no card no timings), its rows' configurations held to the root
``bench.py``'s (read with ``ast``, never imported: it imports JAX and
writes its own record), and a row's numbers held to the march they time.
On the card the whole bench runs from ``chip_smoke.py``'s ``bench`` phase
and by hand (README)."""
import ast
import inspect
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from climatemodel_tpu_torch import bench

ROOT = pathlib.Path(bench.__file__).resolve().parents[1]
#: the port's row functions whose bench.py counterpart has another name
JAX_NAME = {'bench_weak_scaling': 'bench_weak_scaling_cpu',
            'bench_weak_scaling_2d': 'bench_weak_scaling_2d_cpu'}
#: the port's row names that differ from bench.py's
JAX_ROW = {'sw_weak_scaling': 'sw_weak_scaling_cpu_mesh'}
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_bench(args, cwd, **env):
    full_env = dict(os.environ, OMP_NUM_THREADS='1', **env)
    full_env['PYTHONPATH'] = os.pathsep.join(
        [str(ROOT)] + [p for p in full_env.get('PYTHONPATH', '').split(
            os.pathsep) if p])
    return subprocess.run(
        [sys.executable, '-m', 'climatemodel_tpu_torch.bench', *args],
        cwd=cwd, env=full_env, capture_output=True, text=True, timeout=300)


def _stamp(path):
    return path.stat().st_mtime_ns if path.exists() else None


def test_cpu_smoke_row_prints_one_line_and_writes_its_record(tmp_path):
    """``--device cpu --smoke --only=grey_rce_single_column``: rc 0, one
    JSON line under 2000 characters saying platform cpu, the full record
    under --out and nowhere else (no BENCH_FULL.json, nothing in
    build/bench/)."""
    watched = [ROOT / 'BENCH_FULL.json', tmp_path / 'BENCH_FULL.json',
               bench.OUT_PATH]
    before = [_stamp(p) for p in watched]
    out = tmp_path / 'r.json'
    proc = _run_bench(['--device', 'cpu', '--smoke',
                       '--only=grey_rce_single_column', '--out', str(out)],
                      cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) < bench.LINE_LIMIT
    rec = json.loads(lines[0])
    assert rec['metric'] == 'grey_rce_model_days_per_sec'
    assert rec['vs_baseline'] is None and rec['value'] is None
    extra = rec['extra']
    assert extra['platform'] == 'cpu' and extra['smoke'] is True
    assert extra['broken'] == [] and extra['full_record'] == str(out)
    assert list(extra['config_wall_s']) == ['grey_rce_single_column']
    assert extra['grey_rce_single_column'] > 0
    full = json.loads(out.read_text())
    row = full['extra']['grey_rce_single_column']
    assert row['nz'] == 60 and row['launches'] == {}
    for key in ('per_step', 'check_every_8', 'check_every_8_dip'):
        flags = {k: row[key][k] for k in ('converged_fraction', 'equilibrium',
                                          'timed_out', 'failed', 'nan')}
        assert flags == dict(converged_fraction=1.0, equilibrium=True,
                             timed_out=False, failed=False, nan=False)
        assert row[key]['wall_s'] > 0 and row[key]['steps'] > 0
    assert full['extra']['platform'] == 'cpu'
    assert 'roofline_peak_bytes_per_s' not in full['extra']
    assert [_stamp(p) for p in watched] == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ['r.json']


def test_no_card_exits_2_and_times_nothing(tmp_path):
    """Without a CUDA device and without ``--device cpu``: one line with an
    error, exit 2, no rows run and no record written."""
    out = tmp_path / 'r.json'
    proc = _run_bench(['--out', str(out)], cwd=tmp_path,
                      CUDA_VISIBLE_DEVICES='')
    assert proc.returncode == 2, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert 'no CUDA device' in rec['error']
    assert rec['value'] is None and 'extra' not in rec
    assert not out.exists()


def _jax_bench_functions():
    tree = ast.parse((ROOT / 'bench.py').read_text())
    return tree, {n.name: n for n in tree.body
                  if isinstance(n, ast.FunctionDef)}


def _jax_defaults(fn):
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: ast.literal_eval(d)
           for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    out.update({p.arg: ast.literal_eval(d)
                for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return out, [p.arg for p in pos + a.kwonlyargs]


def _port_defaults(fn):
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.name != 'device']
    return ({p.name: p.default for p in params
             if p.default is not inspect.Parameter.empty},
            [p.name for p in params])


def _row_function(fn):
    return fn.func if hasattr(fn, 'func') else fn


@pytest.mark.parametrize('name', [_row_function(f).__name__
                                  for _, f in bench.FULL_ROWS]
                         + ['_thermosphere_world'])
def test_row_defaults_equal_bench_py(name):
    """Each row function takes bench.py's parameters with bench.py's
    defaults (plus the keyword-only ``device``, which it requires)."""
    _, jax_fns = _jax_bench_functions()
    want = _jax_defaults(jax_fns[JAX_NAME.get(name, name)])
    port = getattr(bench, name)
    assert _port_defaults(port) == want
    device = inspect.signature(port).parameters['device']
    assert device.kind == device.KEYWORD_ONLY
    assert device.default is inspect.Parameter.empty


def _config_rows(tree, fn_name):
    """(row name, called function, keywords) of each entry of bench.py's
    ``fn_name`` tuple: the last ``return`` of the function."""
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == fn_name)
    ret = [n for n in fn.body if isinstance(n, ast.Return)][-1]
    rows = []
    for elt in ret.value.elts:
        key, f = elt.elts
        if isinstance(f, ast.Lambda):
            call = f.body
            rows.append((key.value, call.func.id,
                         {k.arg: ast.literal_eval(k.value)
                          for k in call.keywords}))
        else:
            rows.append((key.value, f.id, {}))
    return rows


def test_row_lists_equal_bench_py():
    """The full list has bench.py's rows in bench.py's order (one renamed),
    each through the counterpart of bench.py's function; the smoke list has
    bench.py's smoke rows with their cut configurations."""
    tree, _ = _jax_bench_functions()
    for fn_name, rows in (('_full_configs', bench.FULL_ROWS),
                          ('_smoke_configs', bench.SMOKE_ROWS)):
        got = []
        for key, f in rows:
            func = _row_function(f)
            got.append((JAX_ROW.get(key, key),
                        JAX_NAME.get(func.__name__, func.__name__),
                        dict(getattr(f, 'keywords', {}))))
        assert got == _config_rows(tree, fn_name), fn_name


def test_single_column_row_reports_its_march():
    """The single-column row's steps and simulated days are those of the
    port's own ``evolve_to_equilibrium`` on the same world; the dip-memory
    chunks end where the per-step march does."""
    row = bench.bench_grey_single_column(nz=40, device=CPU)
    world = bench._thermosphere_world(40, device=CPU)
    world.evolve_to_equilibrium(flux_thresh=1e-3, save=False)
    steps = int(world._equilibrium_info.steps)
    days = float(world.state.t.double().sum()) / 86400.0
    for key in ('per_step', 'check_every_8_dip'):
        assert row[key]['steps'] == steps
        assert row[key]['model_days'] == days
        assert row[key]['model_days_per_sec'] == days / row[key]['wall_s']
        assert row[key]['equilibrium'] is True
    assert row['check_every_8']['steps'] >= steps
    assert row['nz'] == 40


def test_errors_and_broken_flags_decide_the_exit_code(monkeypatch, tmp_path,
                                                      capsys):
    """A row that raises is recorded and the run goes on; a failed march
    or a missed required flag is listed under ``broken``; either gives
    exit code 1 and the line still prints."""
    def boom(*, device):
        raise ValueError('x' * 1000)

    def failed(*, device):
        return {'a': {'nan': False, 'failed': True}, 'converged_fraction': 1}

    def unconverged(*, device):
        return {'converged_fraction': 0.5, 'ok': True}
    monkeypatch.setattr(bench, 'FULL_ROWS', (
        ('grey_rce', unconverged), ('real_gas', failed),
        ('shallow_water', boom)))
    out = tmp_path / 'r.json'
    assert bench.main(['--device', 'cpu', '--out', str(out)]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    extra = rec['extra']
    assert extra['broken'] == ['grey_rce.converged_fraction=0.5',
                               'real_gas.a.failed=True']
    assert extra['shallow_water']['error'].startswith('ValueError: xxx')
    assert list(extra['config_wall_s']) == ['grey_rce', 'real_gas',
                                            'shallow_water']
    full = json.loads(out.read_text())['extra']
    assert full['real_gas']['a']['failed']
    assert 'boom' in full['shallow_water']['traceback']
    assert 'traceback' not in extra['shallow_water']
    # the smoke list requires no convergence, only sound marches
    monkeypatch.setattr(bench, 'SMOKE_ROWS', (('grey_rce', unconverged),))
    assert bench.main(['--device', 'cpu', '--smoke', '--out', str(out)]) == 0
    capsys.readouterr()
    # a fault outside the rows still prints the line, with its error

    def broken_runner(rows, device):
        raise KeyError('runner')
    monkeypatch.setattr(bench, 'run_rows', broken_runner)
    assert bench.main(['--device', 'cpu', '--out', str(out)]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec['error'] == "KeyError: 'runner'" and rec['value'] is None


def test_line_stays_short_when_every_row_errors():
    """Twelve rows with long errors and long broken lists still give a
    parseable line under the limit, with every row's key present."""
    extra = {'platform': 'cuda', 'config_wall_s': {}, 'broken':
             [f'row{i}.' + 'y' * 200 + '=False' for i in range(40)]}
    for key, _ in bench.FULL_ROWS:
        extra[key] = {'error': 'RuntimeError: ' + 'z' * 300}
        extra['config_wall_s'][key] = 123.4
    line = bench.compact_line(dict(bench.METRIC, value=None,
                                   vs_baseline=None, extra=extra))
    assert len(line) < bench.LINE_LIMIT
    assert json.loads(line)['extra']['platform'] == 'cuda'
