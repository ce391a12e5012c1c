"""Port vs JAX: the ice-albedo hysteresis sweep (``models/ice_albedo.py``),
the five tests of test_ice_albedo.py run through both packages at their
own sizes in f64.

Each equilibrium of a sweep is a free-running march whose delta-percentile
exit is chaotic in its last bit (ROADMAP Queue 3 note): two f64 marches of
one world end up to ~1.3 K apart (0.4-1.3 K measured on the grey
ensemble; at most 1.19 K over the sweeps here).  So the sweeps' discrete outputs (albedo
arrays, ice-edge latitudes) must be equal, and their surface temperatures
within T_BOUND_K, up to the first sweep point where a latitude flips across
T_ice.  That point is compared by lockstep: every march JAX made there is
stepped by the port from JAX's carry, held to the f64 lockstep bound of
test_torch_ensemble.py, and one of them must end with the flipped latitude
within T_BOUND_K of T_ice (the flip is then a last-bit decision).  The
sweeps follow different branches after it and are compared no further."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import F_sun, p_surface_earth
from climatemodel_tpu.models import ice_albedo as jice
from climatemodel_tpu_torch.models import ice_albedo as pice
from test_torch_column import lockstep_march

LW = dict(tau_lw_func='scale_height',
          tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
CPU64 = dict(dtype=torch.float64, device='cpu')
T_BOUND_K = 1.5
LOCKSTEP_K = 1e-9         # f64 per-step bound (test_torch_ensemble.py)


def _both(*args, **kwargs):
    return (jice.GreyAlbedoFeedback(*args, **kwargs),
            pice.GreyAlbedoFeedback(*args, **kwargs, **CPU64))


def _record_marches(exp):
    """Wrap ``exp``'s sweep so that every march its world makes is recorded
    as (sweep point, starting state with the clock restarted, forcing)."""
    world, marches, point = exp.grey_world, [], [-1]
    update, evolve = exp.update_albedo, world.evolve_to_equilibrium

    def update_albedo(*args, **kwargs):
        point[0] += 1
        return update(*args, **kwargs)

    def evolve_to_equilibrium(*args, **kwargs):
        st = world.state
        marches.append((point[0], st.replace(t=jnp.zeros_like(st.t)),
                        world.forcing))
        return evolve(*args, **kwargs)
    exp.update_albedo = update_albedo
    world.evolve_to_equilibrium = evolve_to_equilibrium
    return marches


def _lockstep_flip(exp_j, marches, k, lats, flux_thresh):
    """Every march JAX made at sweep point k, stepped by the port from
    JAX's carry; returns the distance to T_ice of latitudes ``lats`` at
    the end of each."""
    w, batch = exp_j.grey_world, (lambda x: x[None])  # noqa: E731
    margins = []
    for point, st, forcing in marches:
        if point != k:
            continue
        carry, rec = lockstep_march(
            jax.tree_util.tree_map(batch, st),
            jax.tree_util.tree_map(batch, forcing), w.p_interface,
            w.p[:, 0], flux_thresh, max_steps=500_000, fused=False)
        assert max(r['dT'].max() for r in rec) <= LOCKSTEP_K
        assert all(r['ind_same'].all() and r['flags_same'].all()
                   for r in rec)
        T_surf = np.asarray(carry[0].T)[0, 0, lats]
        margins.append(np.abs(T_surf - exp_j.T_ice).max())
    return margins


def _run_both(exps, *args, **kwargs):
    """Run both sweeps and compare them as the module docstring says.
    Returns the port's outputs."""
    exp_j, exp_p = exps
    marches = _record_marches(exp_j)
    out_j, out_p = (e.run(*args, **kwargs) for e in exps)
    flux_thresh = kwargs.get('delta_net_flux_thresh', 1e-3)
    dT, n_equal = 0.0, 0
    for k, (a_j, a_p) in enumerate(zip(out_j[0], out_p[0])):
        if not np.array_equal(a_j, a_p):
            lats = np.where(a_j != a_p)[0]
            margins = _lockstep_flip(exp_j, marches, k, lats, flux_thresh)
            print(f'sweep point {k}: latitudes {lats.tolist()} flipped; '
                  f'JAX marches there end {np.round(margins, 4).tolist()} K '
                  f'from T_ice')
            assert min(margins) < T_BOUND_K
            break
        assert out_p[1][k] == out_j[1][k]
        dT = max(dT, np.abs(out_p[2][k] - out_j[2][k]).max())
        n_equal += 1
    print(f'max |T_surface port - JAX| {dT:.3g} K over {n_equal} of '
          f'{len(out_p[1])} sweep points')
    assert dT < T_BOUND_K
    return out_p


def test_albedo_step_function():
    lat = np.linspace(-90, 90, 10)
    T = np.where(np.abs(lat) > 60, 250.0, 280.0)
    for args in ((lat,), (lat, T), (lat, np.full(10, 263.0))):
        np.testing.assert_array_equal(pice.albedo_step_function(*args),
                                      jice.albedo_step_function(*args))
    a = pice.albedo_step_function(lat, T)
    assert set(np.unique(a)) == {0.3, 0.6}
    assert np.all(a[np.abs(lat) > 60] == 0.6)
    for v in (-3.0, 52.4, 100.0):
        assert (pice.nearest_value_in_array(lat, v)
                == jice.nearest_value_in_array(lat, v))


def test_sweep_ordering_warm_cold_warm():
    exp_j, exp_p = _both(4.0, np.array([800.0, 1100.0, 1400.0]), nz=20,
                         ny=4, **LW)
    np.testing.assert_array_equal(exp_p.changing_param_values,
                                  exp_j.changing_param_values)
    np.testing.assert_allclose(exp_p.changing_param_values,
                               [1400, 1100, 800, 1100, 1400])
    assert exp_p.changing_param == exp_j.changing_param == 'stellar'
    np.testing.assert_array_equal(exp_p.latitude_plot, exp_j.latitude_plot)
    assert exp_p.grey_world.nz == exp_j.grey_world.nz
    with pytest.raises(ValueError):
        pice.GreyAlbedoFeedback(np.array([1, 2.0]), np.array([1.0, 2]), 20, 4,
                                **LW, **CPU64)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig = exp_p.plot(np.full(5, 90.0), np.full((5, 4), 280.0))
    assert len(fig.axes) == 2 and len(fig.axes[0].lines) == 2
    plt.close(fig)


def test_stellar_sweep_grows_ice_when_cooling():
    exps = _both(4.0, np.array([700.0, 1100.0, 1500.0]), nz=25, ny=8, **LW)
    albedo_array, ice_latitude, T_surface = _run_both(
        exps, delta_albedo=0.15, delta_net_flux_thresh=1e-3)
    assert len(ice_latitude) == 5
    cooling = ice_latitude[:3]
    assert all(a >= b for a, b in zip(cooling, cooling[1:]))
    assert ice_latitude[2] < ice_latitude[0]
    assert T_surface[2].mean() < T_surface[0].mean()
    for a in albedo_array:
        assert np.all((a >= 0.3 - 1e-9) & (a <= 0.6 + 1e-9))


def test_tau_sweep_mutates_grid():
    exps = _both(np.array([2.0, 4.0]), F_sun, nz=20, ny=4, **LW)
    tau0 = exps[1].grey_world.tau_interface.copy()
    _, ice_latitude, _ = _run_both(exps, delta_albedo=0.15,
                                   delta_net_flux_thresh=1e-3)
    assert len(ice_latitude) == 3
    np.testing.assert_array_equal(exps[1].grey_world.tau_interface,
                                  exps[0].grey_world.tau_interface)
    assert exps[1].grey_world.tau_interface[0, 0] == pytest.approx(4.0,
                                                                   rel=1e-6)
    assert not np.allclose(tau0, 0)


def test_hysteresis_loop():
    exps = _both(4.0, np.arange(600.0, 2250.0, 150.0), nz=25, ny=8, **LW)
    _, ice_lat, _ = _run_both(exps, 0.1, delta_net_flux_thresh=1e-3)
    vals = exps[1].changing_param_values
    n_cool = vals.argmin() + 1
    cool = dict(zip(vals[:n_cool], ice_lat[:n_cool]))
    warm = dict(zip(vals[n_cool - 1:], ice_lat[n_cool - 1:]))
    shared = [v for v in cool if v in warm]
    assert all(warm[v] <= cool[v] for v in shared)
    assert any(warm[v] < cool[v] for v in shared)
