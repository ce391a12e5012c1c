"""Port vs JAX: the command-line entry point (``climatemodel_tpu_torch.cli``,
``python -m climatemodel_tpu_torch``).

Each command runs through both packages' ``cli.main`` with the same
arguments (the port with ``--device cpu --dtype float64``, the JAX package
under the tests' x64) and the JSON records are compared: the structural
fields exactly; the march endpoints within the bound of the march's own
last-bit chaos (ROADMAP Queue 3: free-running grey marches part 0.4-1.3 K
at ~300 K, so T within 0.5%, step counts and model days within 10%), never
bit for bit.
"""
import contextlib
import importlib
import io
import json

import numpy as np
import pytest
import torch

from climatemodel_tpu import cli as jcli
from climatemodel_tpu.constants import F_sun
from climatemodel_tpu_torch import cli as pcli
from climatemodel_tpu_torch.models.grey import GreyGas as PGrey
from climatemodel_tpu_torch.utils import checkpoint as pck

CPU64 = ['--device', 'cpu', '--dtype', 'float64']
T_REL = 5e-3
COUNT_REL = 0.1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's parallel loops over the El Nino and ice-albedo fields then spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().splitlines()
    return json.loads(next(x for x in lines if x.startswith('{'))), lines


def both(argv, port_extra=()):
    return run(jcli.main, argv)[0], run(pcli.main, argv + CPU64
                                        + list(port_extra))


def close(a, b, r):
    return abs(a - b) <= r * abs(b)


@pytest.mark.parametrize('name', sorted(jcli.GREY_WORLDS))
def test_grey_presets_equal_jax(name):
    assert pcli.grey_world_kwargs(name) == jcli.grey_world_kwargs(name)
    assert pcli.GREY_WORLDS == jcli.GREY_WORLDS


@pytest.mark.parametrize('name', jcli.SHALLOW_SCENARIOS)
def test_shallow_presets_equal_jax(name):
    assert pcli.shallow_scenario(name) == jcli.shallow_scenario(name)
    assert pcli.SHALLOW_SCENARIOS == jcli.SHALLOW_SCENARIOS


def test_unknown_presets_exit():
    with pytest.raises(SystemExit):
        pcli.grey_world_kwargs('venus')
    with pytest.raises(SystemExit):
        pcli.shallow_scenario('venus')


def test_main_module_imports_without_running(capsys):
    mod = importlib.import_module('climatemodel_tpu_torch.__main__')
    assert mod.main is pcli.main
    assert capsys.readouterr().out == ''


def test_find_tg_without_sweep_exits():
    with pytest.raises(SystemExit, match='--find-tg requires --sweep'):
        pcli.main(['real-gas', '--find-tg'] + CPU64)


def test_no_card_exits_instead_of_falling_back(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        pcli.main(['grey', '--nz', '20'])
    assert e.value.code == 2
    assert 'no CUDA device' in capsys.readouterr().err


@pytest.mark.parametrize('sensitivity', [False, True])
def test_grey_command_matches_jax(tmp_path, sensitivity):
    argv = ['grey', '--nz', '40'] + (['--sensitivity'] if sensitivity
                                     else [])
    out_p, plot_p = tmp_path / 'p_state', tmp_path / 'p.png'
    j = run(jcli.main, argv)[0]
    p, lines = run(pcli.main, argv + CPU64 + ['--out', str(out_p),
                                              '--plot', str(plot_p)])
    assert set(p) == set(j)
    assert (p['world'], p['nz'], p['ny']) == (j['world'], j['nz'], j['ny'])
    assert close(p['T_surface'], j['T_surface'], T_REL)
    assert close(p['steps'], j['steps'], COUNT_REL)
    assert close(p['model_days'], j['model_days'], COUNT_REL)
    assert p['max_net_flux'] < 1.0 and j['max_net_flux'] < 1.0
    if sensitivity:
        assert close(p['dT_surface_dF_stellar'], j['dT_surface_dF_stellar'],
                     1e-2)
        # the exact grey oracle (tests/test_cli.py:121-131)
        oracle = p['T_surface'] / (4.0 * F_sun)
        assert abs(p['dT_surface_dF_stellar'] / oracle - 1) < 0.02
    assert plot_p.stat().st_size > 0
    assert f'plot -> {plot_p}' in lines and f'state -> {out_p}' in lines
    # the state file (the port's batch of one) loads into a fresh world
    kw = dict(nz=40, ny=1, **pcli.grey_world_kwargs('scale_height'))
    st = pck.load_pytree(out_p, PGrey(dtype=torch.float64, device='cpu',
                                      **kw).state)
    assert float(st.T[0].max()) == p['T_surface']
    with np.load(str(out_p) + '.npz') as data:
        np.testing.assert_array_equal(data['leaf_0'], st.T.numpy())


def test_grey_convective_sensitivity_matches_jax():
    """--convective --sensitivity takes the pooled RCE solve: positive and
    under 10 times the oracle (tests/test_cli.py:132-136)."""
    argv = ['grey', '--world', 'thermosphere', '--nz', '60', '--convective',
            '--sensitivity']
    j, (p, _) = both(argv)
    assert close(p['steps'], j['steps'], COUNT_REL)
    assert close(p['T_surface'], j['T_surface'], T_REL)
    assert close(p['dT_surface_dF_stellar'], j['dT_surface_dF_stellar'], 1e-2)
    assert 0 < p['dT_surface_dF_stellar'] < 10 * p['T_surface'] / (4 * F_sun)


def test_real_gas_sweep_find_tg_matches_jax(tmp_path):
    argv = ['real-gas', '--nz', '30', '--sweep', '2', '--find-tg']
    j, (p, lines) = both(argv, ['--out', str(tmp_path / 'ens')])
    assert set(p) == set(j)
    for key in ('molecules', 'nz', 'sweep', 'tg_converged', 'converged'):
        assert p[key] == j[key], key
    np.testing.assert_allclose(p['T_g'], j['T_g'], atol=0.5)
    np.testing.assert_allclose(p['T_surface_air'], j['T_surface_air'],
                               atol=0.5)
    # T_g rises with the insolation scale
    assert np.all(np.diff(p['T_g']) > 0)
    assert f'ensemble states -> {tmp_path / "ens"}' in lines


def test_real_gas_single_column_matches_jax():
    argv = ['real-gas', '--nz', '30', '--n-bands', '30']
    j, (p, _) = both(argv)
    assert set(p) == set(j)
    for key in ('molecules', 'nz', 'n_bands', 'T_g'):
        assert p[key] == j[key], key
    assert close(p['T_surface_air'], j['T_surface_air'], T_REL)
    assert close(p['model_days'], j['model_days'], COUNT_REL)


def test_shallow_el_nino_matches_jax(tmp_path):
    """The README's El Nino command, cut to 3 days."""
    argv = ['shallow', '--scenario', 'el_nino', '--n-days', '3']
    j, (p, lines) = both(argv, ['--plot', str(tmp_path / 'sw.png')])
    for key in ('scenario', 'grid', 'n_days', 'snapshots'):
        assert p[key] == j[key], key
    assert p['snapshots'] == 4
    assert close(p['final_t_days'], j['final_t_days'], 1e-6)
    assert (tmp_path / 'sw.png').stat().st_size > 0


def test_shallow_richtmyer_pallas_solver():
    """--solver richtmyer_pallas takes the fused-kernel path (its plain
    twin on the CPU): the same record as the default plain scheme."""
    argv = ['shallow', '--scenario', 'kelvin_wave', '--n-days', '0.02']
    _, (plain, _) = both(argv)
    fused = run(pcli.main, argv + CPU64 + ['--solver', 'richtmyer_pallas'])[0]
    assert fused['snapshots'] == plain['snapshots']
    assert close(fused['final_t_days'], plain['final_t_days'], 1e-9)


def test_ice_albedo_sweep_matches_jax(tmp_path):
    argv = ['ice-albedo', '--nz', '20', '--ny', '8', '--n-values', '3']
    j, (p, _) = both(argv, ['--out', str(tmp_path / 'sweep'),
                            '--plot', str(tmp_path / 'ice.png')])
    assert p['F_values'] == j['F_values']
    assert p['ice_latitude'] == j['ice_latitude']
    assert all(0.0 <= x <= 90.0 for x in p['ice_latitude'])
    with np.load(tmp_path / 'sweep.npz') as data:
        np.testing.assert_array_equal(data['ice_latitude'],
                                      p['ice_latitude'])
        assert data['T_surface'].shape == (5, 8)
    assert (tmp_path / 'ice.png').stat().st_size > 0
