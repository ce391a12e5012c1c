"""Port vs JAX: the OLR diagnostics (``diagnostics/olr.py``), ``Animate``
(``diagnostics/animation.py``) and every host plot.

The OLR functions run on a small earth column (the four tables built by the
port into a tmp folder, which both packages read) with CO2 on a constant_q
profile: tau is host NumPy in both packages (held bit-equal), the fluxes
f64 within 1e-10 relative, the band areas likewise.  Each plot is built on
Agg from the same inputs in both packages and its plotted arrays (line x/y
data, scatter offsets, image arrays, quiver vectors, chosen frames and
axis limits) are compared: exactly where the inputs are host arrays, within
1e-10 relative where they are the packages' own f64 fluxes.
"""
import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from climatemodel_tpu.diagnostics import animation as jan  # noqa: E402
from climatemodel_tpu.diagnostics import olr as jolr  # noqa: E402
from climatemodel_tpu.models import grey as jgrey  # noqa: E402
from climatemodel_tpu.models import ice_albedo as jice  # noqa: E402
from climatemodel_tpu.models import real_gas as jrg  # noqa: E402
from climatemodel_tpu.models import shallow_water as jsw  # noqa: E402
from climatemodel_tpu.spectral import hitran as jhit  # noqa: E402
from climatemodel_tpu.spectral import humidity as jhum  # noqa: E402
from climatemodel_tpu.spectral import temperature_profiles as jtp  # noqa: E402
from climatemodel_tpu_torch import cli as pcli  # noqa: E402
from climatemodel_tpu_torch.diagnostics import animation as pan  # noqa: E402
from climatemodel_tpu_torch.diagnostics import olr as polr  # noqa: E402
from climatemodel_tpu_torch.models import grey as pgrey  # noqa: E402
from climatemodel_tpu_torch.models import ice_albedo as pice  # noqa: E402
from climatemodel_tpu_torch.models import real_gas as prg  # noqa: E402
from climatemodel_tpu_torch.models import shallow_water as psw  # noqa: E402
from climatemodel_tpu_torch.spectral import earth_tables as pet  # noqa: E402
from climatemodel_tpu_torch.spectral import hitran as phit  # noqa: E402
from climatemodel_tpu_torch.spectral import humidity as phum  # noqa: E402
from climatemodel_tpu_torch.spectral import temperature_profiles as ptp  # noqa: E402,E501

EARTH = ['CO2', 'CH4', 'H2O', 'O3']
REL = 1e-10
CPU64 = dict(device='cpu', dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close('all')


@pytest.fixture(scope='module')
def earth_folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp('lut'))
    pet.ensure_earth_tables(folder)
    return folder


def earth_kw(hum, folder, co2_ppmv=300.0):
    q_funcs = {m: hum.molecules[m]['q'] for m in EARTH}
    q_args = {m: hum.molecules[m]['q_args'] for m in EARTH}
    q_funcs['CO2'] = hum.constant_q
    q_args['CO2'] = (co2_ppmv, 'CO2')
    return dict(nz=40, ny=1, molecule_names=EARTH, q_funcs=q_funcs,
                q_funcs_args=q_args, T_g=288.0, p_toa=0.1,
                delta_temp_change=0.1, table_folder=folder)


def earth_pair(folder):
    jw = jrg.RealGas(dtype=np.float64, T_func=jtp.earth_temp,
                     **earth_kw(jhum, folder))
    pw = prg.RealGas(T_func=ptp.earth_temp, **earth_kw(phum, folder), **CPU64)
    return jw, pw


def figure_data(fig):
    """Every plotted array of a figure, axes by axes: line x/y data,
    collection offsets and arrays, image arrays, quiver vectors."""
    out = []
    for ax in fig.axes:
        for line in ax.lines:
            out.append(('line', np.asarray(line.get_xdata(), float),
                        np.asarray(line.get_ydata(), float)))
        for c in ax.collections:
            if hasattr(c, 'U'):
                out.append(('quiver', np.asarray(c.U), np.asarray(c.V)))
            out.append(('offsets', np.asarray(c.get_offsets(), float)))
            arr = c.get_array()
            if arr is not None:
                out.append(('array', np.asarray(arr, float)))
        for im in ax.images:
            out.append(('image', np.asarray(im.get_array(), float)))
        out.append(('lims', np.asarray(ax.get_xlim() + ax.get_ylim())))
    return out


def assert_same_figure(fp, fj, rtol=0.0):
    dp, dj = figure_data(fp), figure_data(fj)
    assert [d[0] for d in dp] == [d[0] for d in dj]
    assert len(dp) > 1
    for a, b in zip(dp, dj):
        for x, y in zip(a[1:], b[1:]):
            assert x.shape == y.shape, a[0]
            if rtol:
                assert rel(x, y) <= rtol, a[0]
            else:
                np.testing.assert_array_equal(x, y, err_msg=a[0])


# --------------------------------------------------------------------------
# diagnostics/olr.py
# --------------------------------------------------------------------------

def test_update_tau_and_flux_match_jax(earth_folder):
    jw, pw = earth_pair(earth_folder)
    np.testing.assert_array_equal(pw.tau_interface, jw.tau_interface)
    q = dict(pw.q_funcs_args, CO2=(600.0, 'CO2'))
    jolr.update_flux(jw, dict(q), jtp.earth_temp)
    polr.update_flux(pw, dict(q), ptp.earth_temp)
    np.testing.assert_array_equal(pw.tau_interface, jw.tau_interface)
    for key in ('up_flux', 'down_flux', 'net_flux'):
        assert rel(getattr(pw, key), getattr(jw, key)) <= REL, key


def test_olr_areas_match_jax(earth_folder):
    jw, pw = earth_pair(earth_folder)
    a_p, a_j = polr.get_olr_area(pw), jolr.get_olr_area(jw)
    assert 100 < a_p < 500
    assert rel(a_p, a_j) <= REL
    s_p = polr.get_surface_up_flux_olr_area(pw)
    assert rel(s_p, jolr.get_surface_up_flux_olr_area(jw)) <= REL
    assert 0 < s_p < 1.5 * a_p
    assert polr.eqv_ppmv('CH4', 16.0) == jolr.eqv_ppmv('CH4', 16.0) == 44.0


def test_olr_area_add_ghg_matches_jax(earth_folder):
    jw, pw = earth_pair(earth_folder)
    added = np.array([0.0, 200.0, 600.0])
    tot_p, surf_p = polr.get_olr_area_add_ghg(pw, 'CO2', added,
                                              ptp.earth_temp)
    tot_j, surf_j = jolr.get_olr_area_add_ghg(jw, 'CO2', added,
                                              jtp.earth_temp)
    assert rel(tot_p, tot_j) <= REL and rel(surf_p, surf_j) <= REL
    assert tot_p[2] < tot_p[1] < tot_p[0]
    with pytest.raises(ValueError, match='0 as the first value'):
        polr.get_olr_area_add_ghg(pw, 'CO2', np.array([10.0]),
                                  ptp.earth_temp)
    q_funcs = dict(pw.q_funcs, CO2=phum.co2)
    q_args = dict(pw.q_funcs_args, CO2=(370, 80000))
    pw2 = prg.RealGas(T_func=ptp.earth_temp, **dict(
        earth_kw(phum, earth_folder), q_funcs=q_funcs, q_funcs_args=q_args),
        **CPU64)
    with pytest.raises(ValueError, match='constant_q'):
        polr.get_olr_area_add_ghg(pw2, 'CO2', added, ptp.earth_temp)


@pytest.mark.parametrize('molecule', [None, 'CH4'])
def test_ghg_activity_matches_jax(earth_folder, molecule):
    jw, pw = earth_pair(earth_folder)
    nu_p, act_p = polr.get_ghg_activity(pw, molecule)
    nu_j, act_j = jolr.get_ghg_activity(jw, molecule)
    np.testing.assert_array_equal(nu_p, nu_j)
    assert rel(act_p, act_j) <= REL
    assert np.isfinite(act_p).all() and act_p.size == nu_p.size > 0


def test_ghg_diff_plot_and_T_q_plot_match_jax(earth_folder):
    jw, pw = earth_pair(earth_folder)
    fp, axp = plt.subplots()
    fj, axj = plt.subplots()
    added = np.array([0.0, 50.0])
    polr.ghg_diff_initial_h2o_plot(axp, pw, [1.0, 2.0], 'CO2', added,
                                   ptp.earth_temp)
    jolr.ghg_diff_initial_h2o_plot(axj, jw, [1.0, 2.0], 'CO2', added,
                                   jtp.earth_temp)
    assert len(axp.lines) == 2
    assert_same_figure(fp, fj, rtol=1e-8)
    # the composition is restored afterwards
    assert pw.q_funcs_args['H2O'] == jw.q_funcs_args['H2O']
    assert_same_figure(polr.plot_T_q(pw), jolr.plot_T_q(jw))


# --------------------------------------------------------------------------
# model plots
# --------------------------------------------------------------------------

def test_real_gas_plots_match_jax(earth_folder):
    jw, pw = earth_pair(earth_folder)
    assert_same_figure(pw.plot_olr().figure, jw.plot_olr().figure, rtol=REL)
    assert_same_figure(pw.plot_incoming_short_wave().figure,
                       jw.plot_incoming_short_wave().figure, rtol=REL)


@pytest.mark.parametrize('world', ['analytic_sw', 'scale_height'])
def test_grey_plot_eqb_matches_jax(world):
    kw = dict(nz=30, ny=1, **pcli.grey_world_kwargs(world))
    jw = jgrey.GreyGas(**kw)
    pw = pgrey.GreyGas(**kw, **CPU64)
    sol_j = jw.equilibrium_sol()[:5]
    sol_p = pw.equilibrium_sol()[:5]
    fp, _ = pw.plot_eqb(*sol_p)
    fj, _ = jw.plot_eqb(*sol_j)
    assert_same_figure(fp, fj, rtol=1e-12)


def test_ice_albedo_plot_matches_jax():
    kw = dict(tau_lw_surface_values=4.0,
              stellar_constant_values=np.linspace(700.0, 1500.0, 3), nz=20,
              ny=8, tau_lw_func='scale_height',
              tau_lw_func_args=[0.22 * 1.0132e5, 4.0])
    rng = np.random.default_rng(7)
    ice = rng.uniform(0.0, 90.0, 5)
    T_s = rng.uniform(200.0, 300.0, (5, 8))
    fp = pice.GreyAlbedoFeedback(**kw, **CPU64).plot(ice, T_s)
    fj = jice.GreyAlbedoFeedback(**kw).plot(ice, T_s)
    assert_same_figure(fp, fj)


def el_nino_worlds():
    kw, _ = pcli.shallow_scenario('el_nino')
    return jsw.ShallowWater(**kw), psw.ShallowWater(**kw, **CPU64)


def test_el_nino_plot_matches_jax():
    jw, pw = el_nino_worlds()
    rng = np.random.default_rng(3)
    t = np.arange(6) * 86400.0
    h = 100.0 + rng.normal(size=(6,) + pw.h.shape)
    assert_same_figure(pw.el_nino_plot(t, h), jw.el_nino_plot(t, h))


def test_plot_animate_matches_jax():
    kw = dict(nx=30, ny=20, dx=1e5, dy=1e5, dt=60.0, f_0=1e-4, beta=0.0,
              orography_info={'type': 'mountain', 'max_h_base': 500.0,
                              'x0': 0.0, 'y0': 0.0, 'x_std': 3e5,
                              'y_std': 3e5},
              initial_info={'type': 'uniform_zonal',
                            'mean_h_surface': 1000.0, 'u_mean': 10.0,
                            'add_noise': False})
    jw, pw = jsw.ShallowWater(**kw), psw.ShallowWater(**kw, **CPU64)
    rng = np.random.default_rng(4)
    n = 9
    t = np.arange(n) * 3600.0
    h = 500.0 + rng.normal(size=(n, 30, 20))
    u, v = rng.normal(size=(2, n, 30, 20))
    ap = pw.plot_animate(t, h, u, v, nPlotFrames=5)
    aj = jw.plot_animate(t, h, u, v, nPlotFrames=5)
    for i in (0, 1, 3):
        pw._animate_frame(i)
        jw._animate_frame(i)
        assert_same_figure(ap._fig, aj._fig)


def test_plot_absorption_coefficient_matches_jax(earth_folder):
    nu_p, k_p = phit.plot_absorption_coefficient('CO2', 5e4, 250.0,
                                                 do_plot=False,
                                                 folder=earth_folder)
    nu_j, k_j = jhit.plot_absorption_coefficient('CO2', 5e4, 250.0,
                                                 do_plot=False,
                                                 folder=earth_folder)
    np.testing.assert_array_equal(nu_p, nu_j)
    np.testing.assert_array_equal(k_p, k_j)
    fp, _ = phit.plot_absorption_coefficient('CO2', 5e4, 250.0,
                                             folder=earth_folder)
    fj, _ = jhit.plot_absorption_coefficient('CO2', 5e4, 250.0,
                                             folder=earth_folder)
    assert_same_figure(fp, fj)
    assert fp.axes[0].get_title() == fj.axes[0].get_title()


# --------------------------------------------------------------------------
# diagnostics/animation.py
# --------------------------------------------------------------------------

def grey_snapshots(ny, n, seed):
    rng = np.random.default_rng(seed)
    kw = dict(nz=25, ny=ny, **pcli.grey_world_kwargs('scale_height'))
    jw, pw = jgrey.GreyGas(**kw), pgrey.GreyGas(**kw, **CPU64)
    shape = pw.T.shape
    # fast change first, then settling (the truncation rule reads it)
    T = [pw.T + 30.0 * (1 - np.exp(-k / 10.0)) + 0.001 * rng.normal(size=shape)
         for k in range(n)]
    t = np.arange(n) * 86400.0 * 7
    flux = {k: [rng.uniform(0, 400, pw.nz) for _ in range(n)]
            for k in ('lw_up', 'lw_down', 'sw_up', 'sw_down')}
    tau = {'lw': [pw.tau for _ in range(n)], 'sw': [pw.tau_sw for _ in range(n)]}
    return jw, pw, T, t, flux, tau


def assert_same_animation(ap, aj):
    np.testing.assert_array_equal(ap.t_plot, aj.t_plot)
    np.testing.assert_array_equal(ap.T_plot, aj.T_plot)
    assert ap.labels == aj.labels
    assert set(ap.ax_lims) == set(aj.ax_lims)
    for k in ap.ax_lims:
        np.testing.assert_array_equal(ap.ax_lims[k], aj.ax_lims[k])
    assert_same_figure(ap.fig, aj.fig)


@pytest.mark.parametrize('show_last_frame', [False, True])
def test_animate_1d_matches_jax(show_last_frame):
    jw, pw, T, t, flux, tau = grey_snapshots(1, 140, 11)
    kw = dict(tau_array=tau, flux_array=flux, nPlotFrames=20,
              show_last_frame=show_last_frame)
    ap = pan.Animate(pw, T, t, pw.equilibrium_sol()[2], True, **kw)
    aj = jan.Animate(jw, T, t, jw.equilibrium_sol()[2], True, **kw)
    assert len(ap.t_plot) < len(t)
    for i in (0, len(ap.t_plot) // 2, len(ap.t_plot) - 1):
        ap._frame_1d(i)
        aj._frame_1d(i)
        assert_same_animation(ap, aj)


def test_animate_2d_matches_jax():
    jw, pw, T, t, _, tau = grey_snapshots(4, 12, 12)
    ap = pan.Animate(pw, T, t, tau_array=tau, nPlotFrames=8)
    aj = jan.Animate(jw, T, t, tau_array=tau, nPlotFrames=8)
    for i in (0, len(ap.t_plot) - 1):
        ap._frame_2d(i)
        aj._frame_2d(i)
        assert_same_animation(ap, aj)
