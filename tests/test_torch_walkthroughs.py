"""Port vs JAX: the narrative walkthroughs and the staged tau ramp
(``climatemodel_tpu_torch/examples``), each at the miniature configuration
of its JAX test (tests/test_walkthroughs.py, tests/test_staged_tau_ramp.py),
on the CPU in f64, asserting the same claims.  The ice-albedo walkthrough
has its own file (tests/test_torch_walkthrough_ice_albedo.py).

What is computed without a march (the adjustment's enthalpies, the OLR
areas and Delta-OLR curves) is held to the JAX script's within 1e-10
relative, on the same input profile.  What is marched is held to the
claims and to a bound: a free-running delta-percentile march is chaotic in
its last bit, so two marches of the same world (JAX vs port) end 0.4-1.3 K
apart at different exit steps (ROADMAP.md, the end of Queue 3); 2 K
covers that.  The JAX scripts are imported by bare module name from
``examples/`` as the JAX tests do; the port's live in a subpackage, so
nothing collides in ``sys.modules``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from climatemodel_tpu_torch.examples import staged_tau_ramp as p_ramp
from climatemodel_tpu_torch.examples import walkthrough_arctic_amplification as p_arctic
from climatemodel_tpu_torch.examples import walkthrough_convective_adjustment as p_conv
from climatemodel_tpu_torch.examples import walkthrough_real_gas as p_rg
from climatemodel_tpu_torch.spectral import hitran as ph

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples'))

F64 = dict(device='cpu', dtype=torch.float64)
#: endpoint bound of two free-running marches of one world (see above)
MARCH_K = 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the marches are many small launches, and parallel
    loops spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_convective_adjustment_walkthrough(tmp_path):
    import walkthrough_convective_adjustment as jw
    out = p_conv.run_walkthrough(nz=100, save_png=True, verbose=False,
                                 out_dir=str(tmp_path), **F64)
    # the notebook's three headline claims (tests/test_walkthroughs.py:16-25)
    assert abs(out['H_adj'] / out['H0'] - 1) < 1e-5
    assert 0 < out['beta'] < 1
    assert out['T_adj'][0] < out['T0'][0]
    assert (tmp_path / 'walkthrough_convective_adjustment.png').exists()

    jout = jw.run_walkthrough(nz=100, save_png=False, verbose=False)
    assert out['world'].nz == jout['world'].nz
    assert np.abs(out['T0'] - jout['T0']).max() < MARCH_K
    # steps 2-5 on JAX's marched profile: the candidates' enthalpies, the
    # blend and the library operator (reference method, f64)
    p = np.asarray(jout['world'].p[:, 0], np.float64)
    a = p_conv.adjust_profile(p, jout['T0'], verbose=False, **F64)
    assert a['groups'] == jout['groups']
    for k in ('H0', 'H_adj', 'beta'):
        assert abs(a[k] / jout[k] - 1) < 1e-10, (k, a[k], jout[k])
    assert _rel(a['T_adj'], jout['T_adj']) < 1e-10


def test_real_gas_walkthrough(tmp_path, monkeypatch):
    """OLR areas at the imposed earth profile: no march, so equal to JAX's
    within 1e-10 relative (both read earth tables built by the same C++
    accumulation)."""
    import walkthrough_real_gas as jw
    monkeypatch.setenv(ph.LUT_ENV, str(tmp_path / 'tables'))
    out = p_rg.run_walkthrough(nz=40, n_nu_bands=40, save_png=True,
                               verbose=False, out_dir=str(tmp_path), **F64)
    areas = out['areas']
    dco2 = areas['CO2'][0] - areas['CO2'][1]
    dch4 = areas['CH4'][0] - areas['CH4'][1]
    assert dco2 > 0 and dch4 > dco2
    assert areas['CO2'][2] < areas['CO2'][1] < areas['CO2'][0]
    assert (tmp_path / 'walkthrough_real_gas.png').exists()

    jout = jw.run_walkthrough(nz=40, n_nu_bands=40, save_png=False,
                              verbose=False)
    assert abs(out['base_area'] / jout['base_area'] - 1) < 1e-10
    for mol in ('CO2', 'CH4', 'O3'):
        assert _rel(areas[mol], jout['areas'][mol]) < 1e-10, mol
        # the differences the claims read, on their own scale
        assert _rel(areas[mol][0] - np.asarray(areas[mol][1:]),
                    jout['areas'][mol][0]
                    - np.asarray(jout['areas'][mol][1:])) < 1e-10, mol


def test_arctic_amplification_walkthrough(tmp_path):
    """The overlap tables built by make_table through the default backend,
    then the Delta-OLR curves: no march, so within 1e-10 relative of JAX's
    (of each curve's largest |Delta-OLR|)."""
    import walkthrough_arctic_amplification as jw
    out = p_arctic.run_walkthrough(nz=50, n_nu_bands=60,
                                   table_folder=str(tmp_path / 'tables'),
                                   save_png=True, verbose=False,
                                   out_dir=str(tmp_path), **F64)
    for mol in ('CO2', 'CH4'):
        last = {s: -out['curves'][(mol, s)][-1] for s in p_arctic.H2O_SCALES}
        assert all(v > 0 for v in last.values()), (mol, last)
        ordered = [last[s] for s in sorted(p_arctic.H2O_SCALES, reverse=True)]
        assert ordered == sorted(ordered), (mol, ordered)
        assert out['amplification'][mol] > 1.3, (mol, out['amplification'])
    assert (tmp_path / 'walkthrough_arctic_amplification.png').exists()

    jout = jw.run_walkthrough(nz=50, n_nu_bands=60,
                              table_folder=str(tmp_path / 'jtables'),
                              save_png=False, verbose=False)
    for name in ('CO2', 'CH4', 'H2O'):
        a = ph.load_table(name, str(tmp_path / 'tables'))
        b = np.load(os.path.join(tmp_path, 'jtables', name + '.npy'),
                    allow_pickle=True).item()
        assert _rel(a['absorption_coef'], b['absorption_coef']) < 1e-14
    for key, curve in out['curves'].items():
        assert _rel(curve, jout['curves'][key]) < 1e-10, key
    for mol in ('CO2', 'CH4'):
        assert abs(out['amplification'][mol]
                   / jout['amplification'][mol] - 1) < 1e-10


def test_staged_tau_ramp_mini(tmp_path):
    """tests/test_staged_tau_ramp.py's configuration and claims, with the
    animation built and saved; JAX's run beside it: the lw ramp is stepped
    identically until the first equilibration (measured: the first 364
    frames within 1e-9 K in f64), and the endpoint within the march bound."""
    import staged_tau_ramp as jr
    kw = dict(nz=60, lw_rate=3e-7, sw_rate=3e-2, t_end_years=10.0,
              max_ramp_steps=4000, n_plot_frames=8)
    world, data = p_ramp.run_staged_tau_ramp(**kw, save_gif=True,
                                             out_dir=str(tmp_path), **F64)
    T = np.asarray(world.T)
    assert world.tau_lw_func_args[1] == 6.0
    assert world.tau_sw_func_args[2] == 0.0
    assert np.isfinite(T).all() and 150 < float(T[0, 0]) < 500
    assert len(data['t']) == len(data['T']) == len(data['tau']['lw'])
    assert len(data['flux']['lw_up']) == len(data['t'])
    assert len(data['t']) > 10
    t = np.asarray(data['t'], dtype=float)
    assert (np.diff(t) >= 0).all()
    assert float(T[0, 0]) > float(np.asarray(data['T'][0])[0, 0])
    assert (tmp_path / 'grey_tau_ramp.gif').exists()

    jworld, jdata = jr.run_staged_tau_ramp(**kw, save_gif=False)
    for k in range(300):
        np.testing.assert_allclose(data['T'][k], np.asarray(jdata['T'][k]),
                                   rtol=0, atol=1e-8, err_msg=str(k))
    assert np.abs(T - np.asarray(jworld.T)).max() < MARCH_K
