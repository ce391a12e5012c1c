"""Port vs JAX: the example scripts that tests/test_walkthroughs.py does not
cover — ``radiation_script``, ``centa_presentation``, ``real_gas_script``
and ``shallow_script`` (``climatemodel_tpu_torch/examples``) — at miniature
configurations of the same kind, on the CPU in f64.

The JAX scripts run their work when imported, so they are not imported
here: each port script is held to its printed claims and, where the output
is computed without a march, to the JAX package's functions on the same
inputs (the centa tables and Delta-OLR curves within 1e-10 relative; the
El Nino run, a fixed number of plain Richtmyer steps, within 1e-10 of the
largest |h|, |u|, |v|).  Marched outputs are held to their claims and to
discrete results (the ice-edge latitudes of a sweep) equal to JAX's.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.diagnostics import olr as jolr
from climatemodel_tpu.models.ice_albedo import GreyAlbedoFeedback as JGAF
from climatemodel_tpu.models.real_gas import RealGas as JRealGas
from climatemodel_tpu.models.shallow_water import ShallowWater as JSW
from climatemodel_tpu.spectral import hitran as jh
from climatemodel_tpu.spectral import humidity as jhum
from climatemodel_tpu.spectral.temperature_profiles import earth_temp as j_earth_temp
from climatemodel_tpu_torch.examples import centa_presentation as p_centa
from climatemodel_tpu_torch.examples import radiation_script as p_rad
from climatemodel_tpu_torch.examples import real_gas_script as p_rgs
from climatemodel_tpu_torch.examples import shallow_script as p_sw
from climatemodel_tpu_torch.spectral import hitran as ph

F64 = dict(device='cpu', dtype=torch.float64)
RAMP = dict(nz=60, lw_rate=3e-7, sw_rate=3e-2, t_end_years=10.0,
            max_ramp_steps=4000, n_plot_frames=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_radiation_script_mini(tmp_path):
    """The four blocks at a small size: the thermosphere world (nz=100)
    marched and animated, its insolation sensitivity against the exact grey
    oracle dT*/dF = T*/(4F) on the active levels (within 10% at this loose
    flux_thresh 0.1 march; measured 8.7%), the staged ramp at its test size,
    and an 8-value sweep whose ice edges equal JAX's sweep."""
    sweep = np.arange(1050.0, 2250.0, 150.0)
    out = p_rad.run_radiation_script(
        nz=100, n_plot_frames=8, ramp_kwargs=RAMP, sweep_values=sweep,
        out_dir=str(tmp_path), verbose=False, **F64)
    T = np.asarray(out['world'].T)
    assert np.isfinite(T).all() and 150 < T.min() and T.max() < 400
    assert out['sensitivity_rel_err'] < 0.1
    assert abs(out['dT_dF'][0, 0] / out['oracle'][0, 0] - 1) < 0.02
    ramp = out['ramp_world']
    assert ramp.tau_lw_func_args[1] == 6.0
    assert ramp.tau_sw_func_args[2] == 0.0
    for name in ('grey_equilibrium.gif', 'grey_tau_ramp.gif',
                 'ice_albedo_hysteresis.png'):
        assert (tmp_path / name).exists(), name
    edges = np.asarray(out['ice_latitude'])
    assert edges.shape == (2 * sweep.size - 1,) and edges.min() < 90
    j = JGAF(4.0, sweep, nz=40, ny=16, tau_lw_func='scale_height',
             tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
    _, j_edges, _ = j.run(0.1, delta_net_flux_thresh=1e-3)
    np.testing.assert_array_equal(edges, np.asarray(j_edges))


def test_centa_presentation_mini(tmp_path):
    """The background-gas table (make_table through the default backend)
    bit-equal to the JAX package's make_table of the same lines; the
    Delta-OLR curves within 1e-10 relative of the JAX package's
    get_olr_area_add_ghg on the same tables; the claim: the thinner the
    background absorber, the larger the forcing."""
    folder = tmp_path / 'tables'
    out = p_centa.run_centa(table_folder=str(folder), out_dir=str(tmp_path),
                            verbose=False, **F64)
    curves, co2 = out['curves'], out['co2_added']
    for scale, c in curves.items():
        assert c[0] == 0 and (np.diff(c) < 0).all(), (scale, c)
    last = [-curves[s][-1] for s in sorted(curves, reverse=True)]
    assert last == sorted(last) and last[-1] > 1.5 * last[0]
    nu_c, act = out['activity']
    assert np.isfinite(act).all() and np.asarray(act).max() > 0
    for name in ('arctic_amplification.png', 'ghg_activity.png'):
        assert (tmp_path / name).exists(), name

    jfolder = tmp_path / 'jtables'
    jfolder.mkdir()
    lines = {'nu': np.linspace(50.0, 1450.0, 60), 'sw': np.full(60, 40.0),
             'gamma_air': np.full(60, 2.0), 'n_air': np.full(60, 0.7)}
    jh.make_table(lines, wavenumber_array=np.arange(0.0, 1505.0, 10.0),
                  p_array=np.array([jh.p_reference]),
                  T_array=np.array([jh.T_reference]),
                  output_folder=str(jfolder))
    a = ph.load_table('H2O_like', str(folder))
    b = jh.load_table('custom', str(jfolder))
    for k in ('p', 'T', 'nu', 'absorption_coef'):
        np.testing.assert_array_equal(a[k], b[k], k)
    os.replace(jfolder / 'custom.npy', jfolder / 'H2O_like.npy')
    shutil.copyfile(folder / 'CO2_no_sw.npy', jfolder / 'CO2_no_sw.npy')
    jhum.molecules.setdefault('H2O_LIKE', dict(jhum.molecules['H2O']))
    for scale in curves:
        atmos = JRealGas(nz=50, ny=1, molecule_names=['CO2_no_sw',
                                                      'H2O_like'],
                         q_funcs={'CO2_no_sw': jhum.constant_q,
                                  'H2O_like': jhum.h2o},
                         q_funcs_args={'CO2_no_sw': (300.0, 'CO2'),
                                       'H2O_like': (scale,)},
                         table_folder=str(jfolder), T_func=j_earth_temp,
                         n_nu_bands=60, delta_temp_change=0.1,
                         dtype=jnp.float64)
        tot, _ = jolr.get_olr_area_add_ghg(atmos, 'CO2_no_sw', co2,
                                           j_earth_temp)
        assert _rel(curves[scale], tot - tot[0]) < 1e-10, scale


def test_real_gas_script_mini(tmp_path, monkeypatch):
    """The earth column (nz=40) marched to equilibrium, a 4-member
    insolation sweep (60 bands) all converged (T_g is pinned at 265.19 K,
    so the surface air stays within a kelvin of the column's), the
    single-line column with its snapshots, animation and plots."""
    monkeypatch.setenv(ph.LUT_ENV, str(tmp_path / 'lut'))
    out = p_rgs.run_real_gas_script(nz=40, n_members=4, ensemble_bands=60,
                                    n_plot_frames=8, out_dir=str(tmp_path),
                                    verbose=False, **F64)
    eq = out['earth_info']
    assert bool(eq.equilibrium) and not bool(eq.failed)
    T = np.asarray(out['earth'].T)
    assert np.isfinite(T).all() and 0 < T.min() and T.max() < 350
    assert out['sweep_converged'].all()
    assert np.abs(out['sweep_T_surface'] - T[-1, 0]).max() < 1.0
    data = out['data']
    assert len(data['t']) == len(data['T']) == len(data['flux']['lw_up'])
    assert len(data['t']) > 2 and np.isfinite(np.asarray(out['gas'].T)).all()
    for name in ('real_gas_earth_olr.png', 'real_gas_equilibrium.gif',
                 'real_gas_olr.png', 'real_gas_sw.png'):
        assert (tmp_path / name).exists(), name


def test_shallow_script_mini(tmp_path):
    """The El Nino scenario for 3 days (of 25) with daily snapshots: a fixed
    number of plain Richtmyer steps, so within 1e-10 of JAX's run (of each
    field's largest magnitude; measured 1.2e-15); the thermocline deeper in
    the west than in the east; the plot written."""
    world, data = p_sw.run_shallow_script(n_days=3.0, out_dir=str(tmp_path),
                                          verbose=False, **F64)
    assert data['h'].shape == (4, 150, 75)
    assert np.isfinite(data['h']).all()
    h = data['h'][-1]
    nx = h.shape[0]
    assert h[1:nx // 4, 1:-1].mean() > h[3 * nx // 4:-1, 1:-1].mean()
    assert (tmp_path / 'el_nino_thermocline.png').exists()
    kw, _days, every = p_sw.el_nino_config()
    jdata = JSW(**kw, numerical_solver='richtmyer').run(n_days=3.0,
                                                        save_every=every)
    np.testing.assert_array_equal(data['t'], np.asarray(jdata['t']))
    for k in ('h', 'u', 'v'):
        assert _rel(data[k], jdata[k]) < 1e-10, k


_RUNS = {'walkthrough_convective_adjustment': ('run_walkthrough', 'save_png'),
         'walkthrough_ice_albedo': ('run_walkthrough', 'save_png'),
         'staged_tau_ramp': ('run_staged_tau_ramp', 'save_gif'),
         'radiation_script': ('run_radiation_script', 'save_figures'),
         'walkthrough_real_gas': ('run_walkthrough', 'save_png'),
         'walkthrough_arctic_amplification': ('run_walkthrough', 'save_png'),
         'centa_presentation': ('run_centa', 'save_png'),
         'real_gas_script': ('run_real_gas_script', 'save_figures'),
         'shallow_script': ('run_shallow_script', 'save_png')}


@pytest.mark.parametrize('name', sorted(_RUNS))
def test_main_runs_its_configuration(name, tmp_path, monkeypatch):
    """Each script's ``main()`` hands its ``run_*`` the script's own
    configuration (``MAIN``), the device and dtype of the command line
    (default: the card, float32) and, with ``--no-figures``, no figure
    to draw (the run is faked: only the wiring is held here)."""
    import importlib
    import types
    mod = importlib.import_module(f'climatemodel_tpu_torch.examples.{name}')
    fn_name, save = _RUNS[name]
    seen = []

    def fake(**kw):
        seen.append(kw)
        return (types.SimpleNamespace(T=np.zeros((1, 1))), {'t': []})
    monkeypatch.setattr(mod, fn_name, fake)
    mod.main(['--out-dir', str(tmp_path)])
    mod.main(['--device', 'cpu', '--dtype', 'float64', '--no-figures'])
    drawn, quiet = seen
    for kw in seen:
        assert {k: kw[k] for k in mod.MAIN} == mod.MAIN
    assert (drawn['device'], drawn['dtype']) == ('cuda', torch.float32)
    assert drawn['out_dir'] == str(tmp_path) and drawn.get(save, True)
    assert (quiet['device'], quiet['dtype']) == ('cpu', torch.float64)
    assert quiet[save] is False
    if name == 'staged_tau_ramp':
        assert quiet['n_plot_frames'] == 0
